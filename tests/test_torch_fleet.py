"""The port's loopback fleet, its checkpoints and its fleet counters against
the JAX package's.

Mirrors the loopback cases of tests/test_fleet.py on reduced smollm-360m
(and zamba2-7b where named), JAX float32 weights bridged into the port.
Killing one worker mid-decode loses no request, and every stream, greedy
and seed-pinned sampled, equals one undisturbed port engine's bit for bit;
the fleet counters (workers lost, failovers, requests and tokens
replayed, heartbeat misses, spares left) equal a JAX fleet's driven the
same way on the same weights.  The same for a fleet without checkpoints
(replay from the client's record), a straggler under and past the miss
limit, abort with the duplicate-rid guard, and ``ServingClient(workers=2)``.
Checkpoints cross between the packages in both directions with equal
manifests, and a changed structure raises in both.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED_ARCHS
from repro.distributed import checkpoint as jckpt
from repro.models import model as JM
from repro.serving.core import EngineStats as JStats, Request as JRequest
from repro.serving.fleet.router import FleetRouter as JFleet
from repro.serving.scheduler import SamplingParams as JSampling
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.launch.serve import build_client
from repro_torch.serving.client import ServingClient
from repro_torch.serving.core import EngineCore, EngineStats, Request
from repro_torch.serving.fleet.router import FleetRouter
from repro_torch.serving.fleet.transport import TransportClosed, unwrap
from repro_torch.serving.fleet.worker import build_core
from repro_torch.serving.scheduler import SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)

ENG = dict(max_batch=2, max_seq=48, eos_id=-1, page_size=8)
ARCHS = {"dense": "smollm-360m", "hybrid": "zamba2-7b",
         "moe": "qwen2-moe-a2.7b"}


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, JAX float32 params, port cfg, bridged params)."""
    jcfg = ASSIGNED_ARCHS[arch].reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                             max_seq=64)
    return (jcfg, jparams, get_arch(arch).reduced(),
            params_from_numpy(jax.tree.map(np.asarray, jparams)))


@pytest.fixture(scope="module", params=sorted(ARCHS),
                ids=lambda f: f"fam_{f}")
def fam(request):
    return _models(ARCHS[request.param])


@pytest.fixture(scope="module")
def dense():
    return _models("smollm-360m")


def _reqs(n, max_new=10, jax_side=False):
    """Mixed greedy / sampled requests; odd rids get pinned seeds, as
    tests/test_fleet.py's ``_reqs``."""
    R, S = (JRequest, JSampling) if jax_side else (Request, SamplingParams)
    out = []
    for rid in range(n):
        sp = (S(temperature=0.9, top_k=20, seed=100 + rid)
              if rid % 2 == 1 else None)
        out.append(R(rid=rid, prompt=[2 + rid, 5, 9 + rid],
                     max_new_tokens=max_new, sampling=sp))
    return out


def _solo(cfg, params, reqs):
    """The oracle: one undisturbed port engine, same requests."""
    eng = EngineCore(cfg, params, **ENG, device="cpu")
    for r in reqs:
        eng.add_request(r)
    eng.run()
    assert all(r.done for r in reqs)
    return {r.rid: list(r.out_tokens) for r in reqs}


def _fleets(fam, **kw):
    jcfg, jparams, cfg, params = fam
    return (FleetRouter.build_loopback(cfg, params, **kw, **ENG,
                                       device="cpu"),
            JFleet.build_loopback(jcfg, jparams, **kw, **ENG))


def _drive(fl, reqs, at: int, fault, pre=None):
    """Submit, step to the end, apply ``fault(fl)`` after step ``at``."""
    for r in reqs:
        fl.submit(r)
    steps = 0
    while fl.has_work and steps < 500:
        fl.step()
        steps += 1
        if steps == at:
            if pre is not None:
                pre(fl)
            fault(fl)
    assert all(r.done for r in reqs), \
        f"lost: {[r.rid for r in reqs if not r.done]}"
    return {r.rid: list(r.out_tokens) for r in reqs}


def _counters(fl) -> tuple:
    f = fl.fleet
    return (f.workers_lost, f.failovers, f.requests_replayed,
            f.tokens_replayed, f.heartbeat_misses, fl.spares_left,
            len(fl.recovery_s), f.completed)


def _kill(fl):
    fl.workers[0].transport.kill()


def test_loopback_kill_mid_decode_bit_identical(fam):
    """Two workers and a spare, checkpoints every 3 steps, worker 0 killed
    at step 5: nothing lost, the single engine's streams bit for bit, and
    the JAX fleet's counters."""
    ref = _solo(fam[2], fam[3], _reqs(4))
    fl, jfl = _fleets(fam, workers=2, spares=1, checkpoint_every=3)
    try:
        assert _drive(fl, _reqs(4), 5, _kill) == ref
        _drive(jfl, _reqs(4, jax_side=True), 5, _kill)
        assert fl.fleet.workers_lost == 1 and fl.fleet.failovers == 1
        assert fl.fleet.requests_replayed >= 1 and fl.spares_left == 0
        assert _counters(fl) == _counters(jfl)
        s = fl.summary()
        assert "workers_lost=1" in s and "failovers=1" in s
    finally:
        fl.close()
        jfl.close()


def test_from_scratch_replay_without_checkpoints(dense):
    """``checkpoint_every=0``: failover replays from the client's record;
    every token delivered before the kill re-decodes and is suppressed."""
    ref = _solo(dense[2], dense[3], _reqs(4))
    fl, jfl = _fleets(dense, workers=2, spares=0, checkpoint_every=0,
                      migrate=False)
    delivered = []

    def count(fl):
        w0 = fl.workers[0]
        delivered.append(sum(len(r.out_tokens) for r in fl._reqs.values()
                             if fl._owner.get(r.rid) is w0))
    try:
        assert _drive(fl, _reqs(4), 6, _kill, pre=count) == ref
        _drive(jfl, _reqs(4, jax_side=True), 6, _kill)
        assert fl.fleet.tokens_replayed >= delivered[0] > 0
        assert _counters(fl) == _counters(jfl)
    finally:
        fl.close()
        jfl.close()


@pytest.mark.parametrize("miss_limit,stall,ckpt", [(10, 3, 0), (2, 1000, 3)],
                         ids=["recovers", "past_limit"])
def test_straggler(dense, miss_limit, stall, ckpt):
    """A stall under the miss limit: three heartbeat misses, the late
    replies delivered, no failover.  Past it: failed over like a death.
    Streams bit for bit either way; the JAX fleet's counters."""
    ref = _solo(dense[2], dense[3], _reqs(4))
    fl, jfl = _fleets(dense, workers=2, spares=0, checkpoint_every=ckpt,
                      migrate=False, miss_limit=miss_limit)
    at = 4 if stall == 3 else 5

    def straggle(fl):
        fl.workers[0].transport.stall(stall)
    try:
        assert _drive(fl, _reqs(4), at, straggle) == ref
        _drive(jfl, _reqs(4, jax_side=True), at, straggle)
        if stall == 3:
            assert fl.fleet.heartbeat_misses == 3
            assert fl.fleet.workers_lost == 0 and fl.fleet.failovers == 0
            assert all(w.state == "alive" for w in fl.workers)
        else:
            assert fl.fleet.failovers == 1
            assert fl.fleet.heartbeat_misses >= 3
        assert _counters(fl) == _counters(jfl)
    finally:
        fl.close()
        jfl.close()


def test_fleet_abort_and_duplicate_rid_guard(dense):
    fl, jfl = _fleets(dense, workers=2, spares=0)
    try:
        finals = []
        for f, jax_side in ((fl, False), (jfl, True)):
            reqs = _reqs(3, max_new=12, jax_side=jax_side)
            for r in reqs:
                f.submit(r)
            R = JRequest if jax_side else Request
            with pytest.raises(ValueError, match="already submitted"):
                f.submit(R(rid=0, prompt=[1], max_new_tokens=2))
            for _ in range(3):
                f.step()
            assert f.abort(1)
            events, steps = [], 0
            while f.has_work and steps < 200:
                events += f.step()
                steps += 1
            assert reqs[0].done and reqs[2].done
            assert sum(1 for e in events if e.finished and e.rid == 1) == 1
            finals.append({e.rid: e.finish_reason for e in events
                           if e.finished})
        assert finals[0][1] == "aborted"
        assert finals[0] == finals[1]
    finally:
        fl.close()
        jfl.close()


def test_serving_client_over_loopback_fleet(dense):
    """``workers=N`` builds a loopback FleetRouter; handles stream through
    a worker killed mid-run, with the single client's streams; a socket
    transport is refused, as in the JAX client."""
    _, _, cfg, params = dense

    def submit(client):
        return [client.submit([3 + i, 5], max_new_tokens=8,
                              sampling=SamplingParams(temperature=0.8,
                                                      top_k=20)
                              if i % 2 else None)
                for i in range(4)]
    solo = ServingClient(cfg, params, replicas=1, seed_base=7, **ENG,
                         device="cpu")
    ref_handles = submit(solo)
    solo.run()
    ref = {h.rid: list(h.request.out_tokens) for h in ref_handles}
    client = ServingClient(cfg, params, workers=2, spares=1, seed_base=7,
                           **ENG, device="cpu")
    try:
        assert isinstance(client.router, FleetRouter)
        handles = submit(client)
        for _ in range(4):
            client.pump()
        client.router.workers[0].transport.kill()
        client.run()
        assert all(h.finished for h in handles)
        assert {h.rid: list(h.request.out_tokens) for h in handles} == ref
        assert client.router.fleet.workers_lost == 1
        assert "fleet:" in client.summary()
    finally:
        client.router.close()
    with pytest.raises(ValueError, match="loopback fleets only"):
        ServingClient(cfg, params, workers=2, transport="socket", **ENG,
                      device="cpu")


def test_transport_closed_after_kill(dense):
    from repro_torch.serving.fleet.transport import LoopbackTransport
    from repro_torch.serving.fleet.worker import WorkerHost

    t = LoopbackTransport(WorkerHost(EngineCore(dense[2], dense[3], **ENG,
                                                device="cpu")))
    assert unwrap(t.call("ping", {})) == "worker"
    t.kill()
    with pytest.raises(TransportClosed):
        t.call("ping", {})


# ------------------------------------------------------------ checkpoints
def _trees():
    blobs = {str(rid): np.frombuffer(os.urandom(n), np.uint8)
             for rid, n in ((3, 17), (10, 5), (2, 64))}
    nested = {"a": [np.arange(6, dtype=np.int32).reshape(2, 3),
                    (np.float32(1.5) * np.ones(4, np.float32), None)],
              "b": None, "c": {"x": np.arange(3, dtype=np.int8)},
              "d": (np.zeros((0, 2), np.float64),)}
    bf = np.random.RandomState(0).randn(3, 5).astype(ml_dtypes.bfloat16)
    return [("blobs", blobs), ("nested", nested), ("bf16", {"w": bf})]


def _port_form(tree):
    """The same tree as the port holds it: bf16 leaves as torch tensors."""
    return jax.tree.map(
        lambda a: (torch.from_numpy(np.asarray(a).view(np.int16).copy())
                   .view(torch.bfloat16)
                   if np.asarray(a).dtype == ml_dtypes.bfloat16 else a), tree)


def _as_np(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("name", ["blobs", "nested", "bf16"])
def test_checkpoints_cross_between_packages(tmp_path, name):
    tree = dict(_trees())[name]
    ptree = _port_form(tree)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, 7, tree, extra={"k": 1})
    tckpt.save_checkpoint(tdir, 7, ptree, extra={"k": 1})
    with open(os.path.join(jdir, "step_00000007", "manifest.json")) as f:
        jman = f.read()
    with open(os.path.join(tdir, "step_00000007", "manifest.json")) as f:
        tman = f.read()
    assert jman == tman
    assert tckpt.latest_step(tdir) == jckpt.latest_step(jdir) == 7
    # the port restores JAX's save; JAX restores the port's
    got, extra = tckpt.restore_checkpoint(jdir, ptree)
    assert extra == {"k": 1}
    back, _ = jckpt.restore_checkpoint(tdir, tree)
    for want, a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor)),
            jax.tree.leaves(back)):
        assert np.array_equal(_as_np(want), _as_np(a))
        assert np.array_equal(_as_np(want), _as_np(b))
        if np.asarray(want).dtype == ml_dtypes.bfloat16:
            assert a.dtype == torch.bfloat16
    # a changed structure (one rid key renamed) raises in both packages
    if name == "blobs":
        k0 = sorted(tree)[0]
        moved = {("99" if k == k0 else k): v for k, v in tree.items()}
        with pytest.raises(ValueError, match="treedef"):
            tckpt.restore_checkpoint(jdir, moved)
        with pytest.raises(ValueError, match="treedef"):
            jckpt.restore_checkpoint(tdir, moved)
    else:
        wrong = {**ptree, "extra_leaf": np.zeros(1)}
        with pytest.raises(ValueError):
            tckpt.restore_checkpoint(jdir, wrong)


def test_checkpoint_keeps_last_k_and_checks_dtype(tmp_path):
    d = str(tmp_path)
    for step in range(5):
        tckpt.save_checkpoint(d, step, {"x": np.full(3, step, np.int32)},
                              keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    tree, _ = tckpt.restore_checkpoint(d, {"x": np.zeros(3, np.int32)})
    assert (tree["x"] == 4).all()
    with pytest.raises(ValueError, match="dtype"):
        tckpt.restore_checkpoint(d, {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(d, {"x": np.zeros(4, np.int32)})
    assert tckpt.latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------- stats + build
def test_engine_stats_fields_match_jax():
    """The JAX fields in JAX's order (the port adds ``wall_prefill_s``),
    and the fleet line of the summary."""
    port = [f.name for f in dataclasses.fields(EngineStats)]
    jaxf = [f.name for f in dataclasses.fields(JStats)]
    assert [n for n in port if n != "wall_prefill_s"] == jaxf
    kw = dict(workers_lost=1, failovers=1, requests_replayed=2,
              tokens_replayed=5, heartbeat_misses=3)
    s, js = EngineStats(**kw).summary(), JStats(**kw).summary()
    assert s.split("admission")[1] == js.split("admission")[1]


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_worker_params_equal_build_client(quant):
    """A worker's ``build_core`` holds the driver's ``build_client`` bits."""
    _, client = build_client("smollm-360m", reduced=True, quant=quant,
                             max_seq=48, max_batch=2, device="cpu")
    want = client.router.cores[0].params
    got = build_core("smollm-360m", quant=quant, max_seq=48, max_batch=2,
                     device="cpu").params
    flat_w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    flat_g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    assert len(flat_w) == len(flat_g) > 0
    for a, b in zip(flat_w, flat_g):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_frame_cap_holds_a_full_width_checkpoint():
    """A worker's checkpoint reply holds every active slot's pages: at
    llama2-7b's full width, 4 slots at 1,024 tokens are 2 GiB of pages,
    which the JAX package's 256 MiB frame cap refuses; the port's cap (the
    header's u32 limit) takes it, and a frame over the cap still raises."""
    from repro.serving.fleet import wire as jwire
    from repro_torch.models import model as TM
    from repro_torch.serving.fleet import wire
    from repro_torch.serving.kv_cache import pages_needed

    cfg = get_arch("llama2-7b")
    reply = 4 * pages_needed(1024, 16) * TM.kv_page_bytes(cfg, 16,
                                                         torch.bfloat16)
    assert reply == 2 * 2**30
    assert jwire.MAX_PAYLOAD < reply <= wire.MAX_PAYLOAD
    assert wire.MAX_PAYLOAD == 2**32 - 1
    with pytest.raises(wire.ProtocolError):
        wire.FrameDecoder(max_payload=16).feed(wire.frame(b"x" * 17))
