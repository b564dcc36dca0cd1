"""The port's slot migration and its wire format against the JAX package's.

Mirrors the migration cases of tests/test_router.py and the snapshot
format of tests/test_fleet.py.  A request snapshotted mid-decode on one
engine and injected into another emits the unmigrated stream, bit for bit
(dense and hybrid, the Mamba state carried; a seed-pinned sampled request
moved there and back; a slot mid chunked prefill; a suspended slot whose
pages sit in the flash tier); ``Router(migrate=True)`` drains a starved
replica into a donor with the single-replica streams and the JAX router's
migration count on the same bridged weights and margin-checked prompts;
``inject_slot`` refuses mismatched geometry and full replicas.  The port's
``SlotSnapshot`` bytes (bf16 and int8 pages, the hybrid state) decode in
``repro.serving.fleet.wire.snapshot_from_bytes`` to the same pages, and
JAX's bytes decode in the port's; frames and values encode to the same
bytes.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED_ARCHS
from repro.models import model as JM
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro.serving.fleet import wire as jwire
from repro.serving.router import Router as JRouter
from repro.serving.scheduler import SamplingParams as JSampling
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving.core import EngineCore, Request, SlotSnapshot
from repro_torch.serving.fleet import wire
from repro_torch.serving.kv_cache import OutOfPages
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import SamplingParams, make_scheduler
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_serving import _prompts

ENG = dict(max_batch=2, max_seq=48, eos_id=-1, page_size=8)
ARCHS = {"dense": "smollm-360m", "hybrid": "zamba2-7b",
         "moe": "qwen2-moe-a2.7b"}


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
    cfg = get_arch(ARCHS[request.param]).reduced()
    return request.param, cfg, TM.init_params(
        cfg, seed=0, max_seq=64, device="cpu", dtype=torch.float32)


def _core(cfg, params, **kw):
    return EngineCore(cfg, params, **{**ENG, **kw}, device="cpu")


def _solo(cfg, params, prompt, max_new, **kw):
    r = Request(rid=0, prompt=list(prompt), max_new_tokens=max_new, **kw)
    eng = _core(cfg, params)
    eng.add_request(r)
    eng.run()
    return r


# ------------------------------------------------------------- engines
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_slot_migration_bit_identity(fam, overlap):
    """Snapshot mid-decode on A, inject into B (through the snapshot's
    bytes): B finishes with the single-engine stream; both pools recycle."""
    family, cfg, params = fam
    solo = _solo(cfg, params, [11, 12, 13, 14], 8)
    a, b = _core(cfg, params, overlap=overlap), _core(cfg, params,
                                                      overlap=overlap)
    a.add_request(Request(rid=0, prompt=[11, 12, 13, 14], max_new_tokens=8))
    for _ in range(3):
        a.step()
    snap = SlotSnapshot.from_bytes(a.snapshot_slot(0).to_bytes(),
                                   expect_family=family,
                                   expect_page_size=8)
    assert 0 < len(snap.req.out_tokens) < 8
    assert (snap.ssm is not None) == (family == "hybrid")
    assert not a.has_work and a.allocator.available == a.num_pages - 1
    b.inject_slot(snap)
    while b.has_work:
        b.step()
    assert snap.req.out_tokens == solo.out_tokens
    assert snap.req.finish_reason == solo.finish_reason
    assert snap.req.n_migrated == 1
    assert a.stats.migrated_out == 1 and b.stats.migrated_in == 1
    assert b.allocator.available == b.num_pages - 1


def test_migration_roundtrip_stochastic(f32):
    """A -> B -> A of a seed-pinned sampled request: the same stream; the
    snapshot holds host tensors and Python scalars only."""
    _, _, cfg, params = f32
    sp = SamplingParams(temperature=0.8, top_k=20, seed=7)
    solo = _solo(cfg, params, [5, 6, 7], 9, sampling=sp)
    a, b = _core(cfg, params), _core(cfg, params)
    mig = Request(rid=0, prompt=[5, 6, 7], max_new_tokens=9, sampling=sp)
    a.add_request(mig)
    a.step()
    snap = a.snapshot_slot(0)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for p in snap.pages for x in p)
    assert isinstance(snap.slot_len, int) and isinstance(snap.last_token, int)
    b.inject_slot(snap)
    for _ in range(3):
        b.step()
    a.inject_slot(b.snapshot_slot(0))
    while a.has_work:
        a.step()
    assert mig.out_tokens == solo.out_tokens and mig.n_migrated == 2


def test_migration_mid_chunked_prefill(f32):
    """A slot snapshotted mid chunked prefill finishes its chunks on the
    donor: the same stream, no chunk lost or repeated."""
    _, _, cfg, params = f32
    prompt = list(range(1, 21))
    sched = dict(scheduler=make_scheduler("fcfs", chunk_tokens=4))
    ref = Request(rid=0, prompt=list(prompt), max_new_tokens=6)
    eng = _core(cfg, params, **sched)
    eng.add_request(ref)
    eng.run()
    a = _core(cfg, params, scheduler=make_scheduler("fcfs", chunk_tokens=4))
    b = _core(cfg, params, scheduler=make_scheduler("fcfs", chunk_tokens=4))
    mig = Request(rid=0, prompt=list(prompt), max_new_tokens=6)
    a.add_request(mig)
    a.step()
    a.step()
    assert a.prefilling[0] and 0 < a.prefill_pos[0] < len(prompt)
    snap = a.snapshot_slot(0)
    assert snap.prefilling and snap.slot_len == snap.prefill_pos
    b.inject_slot(snap)
    while b.has_work:
        b.step()
    assert mig.out_tokens == ref.out_tokens and mig.n_chunks == ref.n_chunks


def test_migration_of_suspended_slot(f32):
    """A suspended slot with pages in the flash tier snapshots straight
    from the cold store and resumes bit-identical on another engine."""
    _, _, cfg, params = f32
    kw = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8)

    def reqs():
        return [Request(rid=i, prompt=[2 + i] * (3 + i), max_new_tokens=12)
                for i in range(3)]

    base = reqs()
    eng = EngineCore(cfg, params, **kw, device="cpu")
    for r in base:
        eng.add_request(r)
    eng.run()
    a = EngineCore(cfg, params, **kw, num_pages=6, kv_tier="flash",
                   device="cpu")
    b = EngineCore(cfg, params, **kw, device="cpu")
    moved = reqs()
    for r in moved:
        a.add_request(r)

    def cold_suspended():
        return [i for i in range(a.max_batch)
                if a.suspended[i] and 0 in a.slot_pages[i]]

    for _ in range(200):
        if cold_suspended():
            break
        a.step()
    assert cold_suspended(), "pool pressure never spilled a suspended slot"
    b.inject_slot(a.snapshot_slot(a.slots[cold_suspended()[0]].rid))
    while a.has_work or b.has_work:
        if a.has_work:
            a.step()
        if b.has_work:
            b.step()
    assert [r.out_tokens for r in moved] == [r.out_tokens for r in base]


def _starved_pair(cores_cls, cfg, params, **extra):
    kw = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8, **extra)
    starved = cores_cls(cfg, params, **kw, num_pages=6, kv_tier="flash")
    donor = cores_cls(cfg, params, **kw)
    cores = [None, None]
    hot = zlib.crc32(b"hot") % 2
    cores[hot], cores[1 - hot] = starved, donor
    return starved, donor, cores


def test_router_migrates_off_starved_replica(f32):
    """Every request piled on one tiered replica (session affinity), an
    idle donor beside it: the router drains starved slots into the donor;
    the streams equal the single-replica run's and the JAX router's, with
    the same number of migrations; both pools recycle."""
    jcfg, jparams, cfg, params = f32
    prompts = _prompts(f32, 4, 3, 7, 12, seed=8)
    ref = []
    for p in prompts:
        ref.append(_solo(cfg, params, p, 12).out_tokens)

    def run(engine_cls, router_cls, req_cls, cfg_, params_, **extra):
        starved, donor, cores = _starved_pair(engine_cls, cfg_, params_,
                                              **extra)
        rt = router_cls(cores, policy="session_affinity", migrate=True)
        reqs = [req_cls(rid=i, prompt=list(p), max_new_tokens=12,
                        session="hot") for i, p in enumerate(prompts)]
        for r in reqs:
            assert rt.submit(r) is starved
        steps = 0
        while rt.has_work and steps < 500:
            rt.step()
            steps += 1
        for c in (starved, donor):
            assert c.allocator.available == c.num_pages - 1
        assert donor.stats.migrated_in == rt.migrations
        return [r.out_tokens for r in reqs], rt.migrations

    tout, tmig = run(EngineCore, Router, Request, cfg, params, device="cpu")
    jout, jmig = run(JEngine, JRouter, JRequest, jcfg, jparams)
    assert tout == ref == jout
    assert tmig == jmig > 0


def test_inject_guards(f32):
    _, _, cfg, params = f32
    a, b = _core(cfg, params), _core(cfg, params)
    wrong = _core(cfg, params, page_size=16)
    r = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=6)
    a.add_request(r)
    a.step()
    with pytest.raises(KeyError):
        a.snapshot_slot(42)
    snap = a.snapshot_slot(0)
    with pytest.raises(ValueError):
        wrong.inject_slot(snap)            # page_size mismatch
    with pytest.raises(ValueError):
        SlotSnapshot.from_bytes(snap.to_bytes(), expect_page_size=16)
    b.add_request(Request(rid=10, prompt=[1], max_new_tokens=6))
    b.add_request(Request(rid=11, prompt=[2], max_new_tokens=6))
    b.step()
    with pytest.raises(OutOfPages):
        b.inject_slot(snap)                # no free slot
    assert not b.can_accept(snap.n_pages)
    a.inject_slot(snap)                    # its home always takes it back
    while a.has_work:
        a.step()
    assert r.done and len(r.out_tokens) == 6


# ------------------------------------------------------------- the wire
def _jax_engine(jcfg, jparams, kv):
    return JEngine(jcfg, jparams, **ENG, kv_dtype=kv)


def _snapshots(f32, kv):
    """The same request 3 steps in, snapshotted on the port and on JAX."""
    jcfg, jparams, tcfg, tparams = f32
    sp = dict(temperature=0.8, top_k=20, seed=3)
    t = _core(tcfg, tparams, kv_dtype=kv)
    t.add_request(Request(rid=4, prompt=list(range(1, 12)), max_new_tokens=8,
                          sampling=SamplingParams(**sp)))
    j = _jax_engine(jcfg, jparams, kv)
    j.add_request(JRequest(rid=4, prompt=list(range(1, 12)),
                           max_new_tokens=8, sampling=JSampling(**sp)))
    for _ in range(3):
        t.step()
        j.step()
    return t.snapshot_slot(4), j.snapshot_slot(4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _same_fields(got, want, pages_equal=True):
    for name in wire.WIRE_FIELDS["SlotSnapshot"]:
        if name in ("pages", "ssm", "req"):
            continue
        assert getattr(got, name) == getattr(want, name), name
    for name in wire.WIRE_FIELDS["Request"]:
        if name != "sampling":
            assert getattr(got.req, name) == getattr(want.req, name), name
    for name in wire.WIRE_FIELDS["SamplingParams"]:
        assert getattr(got.req.sampling, name) == \
            getattr(want.req.sampling, name), name
    assert len(got.pages) == len(want.pages)
    for gp, wp in zip(got.pages, want.pages):
        assert len(gp) == len(wp)
        for g, w in zip(gp, wp):
            assert _np(g).dtype == _np(w).dtype and g.shape == w.shape
            if pages_equal:
                np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_snapshot_bytes_cross_decode(f32, kv):
    """The port's bytes decode in the JAX codec to the port's pages, and
    JAX's bytes in the port's codec to JAX's pages; the geometry headers
    agree."""
    tsnap, jsnap = _snapshots(f32, kv)
    tbytes, jbytes = tsnap.to_bytes(), jsnap.to_bytes()
    assert wire.peek_snapshot_header(tbytes)[0] == \
        jwire.peek_snapshot_header(jbytes)[0]
    assert jwire.peek_snapshot_header(tbytes)[0]["dtype"] == \
        ("int8" if kv == "int8" else "bfloat16")
    in_jax = jwire.snapshot_from_bytes(tbytes, expect_family="dense",
                                       expect_dtype=("int8" if kv == "int8"
                                                     else "bfloat16"))
    assert type(in_jax).__module__ == "repro.serving.core"
    _same_fields(in_jax, tsnap)
    in_port = wire.snapshot_from_bytes(jbytes, expect_page_size=8)
    assert isinstance(in_port, SlotSnapshot)
    _same_fields(in_port, jsnap)
    # the JAX snapshot decoded here resumes on a port engine
    _, _, tcfg, tparams = f32
    eng = _core(tcfg, tparams, kv_dtype=kv)
    eng.inject_slot(in_port)
    eng.run()
    assert in_port.req.done and len(in_port.req.out_tokens) == 8


def test_hybrid_snapshot_state_cross_decodes():
    """A hybrid snapshot's Mamba checkpoint travels both ways: the port's
    bytes decode in JAX to the same conv and state arrays."""
    cfg = get_arch("zamba2-7b").reduced()
    params = TM.init_params(cfg, seed=0, max_seq=64, device="cpu",
                            dtype=torch.float32)
    eng = EngineCore(cfg, params, **ENG, device="cpu")
    eng.add_request(Request(rid=0, prompt=[3, 4, 5, 6, 7], max_new_tokens=6))
    eng.step()
    eng.step()
    snap = eng.snapshot_slot(0)
    back = jwire.snapshot_from_bytes(snap.to_bytes())
    for part in ("mamba", "tail"):
        if snap.ssm.get(part) is None:
            continue
        for k, v in snap.ssm[part].items():
            np.testing.assert_array_equal(_np(back.ssm[part][k]), _np(v))
    again = wire.snapshot_from_bytes(back.to_bytes())
    for k, v in snap.ssm["mamba"].items():
        assert torch.equal(again.ssm["mamba"][k], v)


def test_values_and_frames_encode_to_the_same_bytes():
    """The port's codec writes JAX's bytes for plain values, bf16 / int8 /
    float32 arrays and frames; each decodes the other's."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4).astype(np.float32)
    jb = jnp.asarray(x, jnp.bfloat16)
    tb = torch.from_numpy(np.asarray(jb).view(np.int16).copy()).view(
        torch.bfloat16)
    i8 = rng.randint(-127, 128, (2, 5)).astype(np.int8)
    plain = {"a": [1, 2.5, None, True, "s", b"y"], 7: (3, False)}
    assert wire.encode(plain) == jwire.encode(plain)
    assert wire.encode(tb) == jwire.encode(np.asarray(jb))
    assert wire.encode(torch.from_numpy(i8)) == jwire.encode(i8)
    assert wire.encode(torch.from_numpy(x)) == jwire.encode(x)
    assert torch.equal(wire.decode(jwire.encode(np.asarray(jb))), tb)
    np.testing.assert_array_equal(
        np.asarray(jwire.decode(wire.encode(tb))).view(np.int16),
        np.asarray(jb).view(np.int16))
    payload = wire.encode({"op": "step", "n": 3})
    assert wire.frame(payload) == jwire.frame(payload)
    dec = wire.FrameDecoder()
    framed = jwire.frame(payload) * 2
    assert dec.feed(framed[:5]) == [] and dec.feed(framed[5:]) == [payload] * 2
    with pytest.raises(wire.ProtocolError):
        wire.FrameDecoder().feed(b"\x00\x00" + framed[2:])
    req = Request(rid=2, prompt=[1, 2], sampling=SamplingParams(top_k=3))
    jreq = jwire.decode(wire.encode(req))
    assert type(jreq).__name__ == "Request" and jreq.prompt == [1, 2]
    assert jreq.sampling.top_k == 3
    assert jwire.WIRE_FIELDS == wire.WIRE_FIELDS
    for name, cls in (("Request", Request), ("SamplingParams",
                                             SamplingParams),
                      ("SlotSnapshot", SlotSnapshot)):
        assert tuple(f.name for f in dataclasses.fields(cls)) == \
            wire.WIRE_FIELDS[name], name
