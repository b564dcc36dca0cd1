"""The port's socket transport: subprocess workers over TCP, and the kernel
build they share.

Two ``--device cpu`` workers (``python -m repro_torch.serving.fleet.worker``)
each rebuild reduced smollm-360m or zamba2-7b from ``(arch, seed)``; one is
SIGKILLed mid-decode, and every request comes back with the stream of one
undisturbed port engine built by the same calls, bit for bit, greedy and
seed-pinned sampled (tests/test_fleet.py's socket case).  A reply split
into 7-byte TCP segments reassembles in ``SocketTransport.recv``, and a
killed worker's transport raises ``TransportClosed``.  Every spawn has a
60 s start-up limit and every receive a timeout, and every worker is
closed in ``finally``.

The kernel build under concurrent processes: two processes calling
``kernels.build.build()`` together on a fresh tree, with a stand-in
compiler on ``PATH`` that counts its runs, compile the sources once and
both get the same library path.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.serving.core import Request
from repro_torch.serving.fleet import wire
from repro_torch.serving.fleet.router import FleetRouter
from repro_torch.serving.fleet.transport import (SocketTransport,
                                                 TransportClosed,
                                                 TransportTimeout,
                                                 spawn_worker, unwrap)
from repro_torch.serving.fleet.worker import build_core
from repro_torch.serving.scheduler import SamplingParams

ENG = dict(max_batch=2, max_seq=48, eos_id=-1, page_size=8)
SPAWN = dict(startup_timeout_s=60.0, reply_timeout_s=30.0)
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _reqs(n, max_new=8):
    out = []
    for rid in range(n):
        sp = (SamplingParams(temperature=0.9, top_k=20, seed=100 + rid)
              if rid % 2 == 1 else None)
        out.append(Request(rid=rid, prompt=[2 + rid, 5, 9 + rid],
                           max_new_tokens=max_new, sampling=sp))
    return out


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b"],
                         ids=["sock_dense", "sock_hybrid"])
def test_socket_sigkill_mid_decode_bit_identical(arch):
    eng = build_core(arch, device="cpu", **ENG)
    ref_reqs = _reqs(4)
    for r in ref_reqs:
        eng.add_request(r)
    eng.run()
    ref = {r.rid: list(r.out_tokens) for r in ref_reqs}
    fl = FleetRouter.build_socket(arch, workers=2, spares=0,
                                  checkpoint_every=3, migrate=False,
                                  device="cpu", **SPAWN, **ENG)
    try:
        reqs = _reqs(4)
        for r in reqs:
            fl.submit(r)
        steps, pid = 0, None
        while fl.has_work and steps < 500:
            fl.step()
            steps += 1
            if steps == 5:
                pid = fl.workers[0].transport.pid
                os.kill(pid, signal.SIGKILL)
        assert pid is not None
        assert all(r.done for r in reqs), \
            f"lost: {[r.rid for r in reqs if not r.done]}"
        assert {r.rid: list(r.out_tokens) for r in reqs} == ref
        assert fl.fleet.workers_lost == 1 and fl.fleet.failovers == 1
        assert fl.fleet.requests_replayed >= 1
        dead = fl.workers[0].transport
        with pytest.raises(TransportClosed):
            dead.call("ping", {}, 5.0)
    finally:
        fl.close()


def test_socket_worker_serves_and_dies_closed():
    """One worker: ping and stats over TCP; after SIGKILL the transport
    raises TransportClosed, never hangs."""
    t = spawn_worker("smollm-360m", device="cpu", startup_timeout_s=60.0,
                     **ENG)
    try:
        assert unwrap(t.call("ping", {}, 30.0)) == "worker"
        stats = unwrap(t.call("stats", {}, 30.0))
        assert stats["mode"] == "continuous" and stats["decode_steps"] == 0
        with pytest.raises(TransportTimeout):
            t.recv(0.2)   # nothing outstanding: a timeout, not a hang
        os.kill(t.pid, signal.SIGKILL)
        t.proc.wait(timeout=30)
        with pytest.raises(TransportClosed):
            t.call("ping", {}, 5.0)
    finally:
        t.terminate()


def test_socket_transport_reassembles_split_frames():
    """A reply with an array, sent in 7-byte segments with pauses, comes
    out of ``recv`` whole; then a closed peer raises TransportClosed."""
    srv = socket.create_server(("127.0.0.1", 0))
    a = socket.create_connection(srv.getsockname(), timeout=30.0)
    b, _ = srv.accept()
    srv.close()
    t = SocketTransport(a)
    arr = np.arange(4096, dtype=np.float32).reshape(64, 64)
    f = wire.frame(wire.encode({"id": 0, "ok": True, "r": arr, "load": {}}))

    def peer():
        for i in range(0, len(f), 7):
            b.sendall(f[i:i + 7])
            if i % 700 == 0:
                time.sleep(0.001)
        b.close()
    th = threading.Thread(target=peer)
    th.start()
    try:
        rep = t.recv(30.0)
        got = unwrap(rep)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), arr)
        th.join(timeout=30)
        with pytest.raises(TransportClosed):
            t.recv(5.0)
    finally:
        t.close()


# ------------------------------------------------------- kernel build lock
_STAND_IN = """\
#!{python}
import os, sys, time
with open({count!r}, "a") as f:
    f.write(" ".join(sys.argv[1:3]) + "\\n")
time.sleep(0.3)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("stand-in object\\n")
"""

_BUILDER = """\
import sys
from pathlib import Path
from repro_torch.kernels import build
build.repo_root = lambda: Path({root!r})
b = build.build()
print(b.path, b.built, Path(b.path).read_text().strip())
"""


def test_kernel_build_runs_once_under_concurrent_processes(tmp_path):
    from repro_torch.kernels import build

    bindir = tmp_path / "bin"
    bindir.mkdir()
    count = tmp_path / "runs.txt"
    nvcc = bindir / "nvcc"
    nvcc.write_text(_STAND_IN.format(python=sys.executable,
                                     count=str(count)))
    nvcc.chmod(0o755)
    root = tmp_path / "checkout"
    env = {**os.environ, "PYTHONPATH": SRC,
           "PATH": f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}"}
    code = _BUILDER.format(root=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    runs = count.read_text().splitlines()
    # one compile a source and one link: a single build between them
    assert len(runs) == len(build.SOURCES) + 1, runs
    assert outs[0][0] == outs[1][0]
    assert sorted(o[1] for o in outs) == ["False", "True"]
    assert all(" ".join(o[2:]) == "stand-in object" for o in outs)
    libdir = root / "build" / "kernels"
    assert not [p for p in libdir.iterdir() if p.name.startswith("tmp-")]
