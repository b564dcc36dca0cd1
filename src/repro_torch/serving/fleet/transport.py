"""Transport seam: how a FleetRouter reaches a worker's EngineCore.

The port's own copy of ``repro.serving.fleet.transport``: the same
surface, the same frames (``serving/fleet/wire.py`` writes JAX's bytes),
and subprocess workers that run ``repro_torch.serving.fleet.worker``.

One transport = one worker.  The conversation is strictly
request/reply — the router is the only client and keeps at most ONE
call outstanding per worker — so the surface is three methods::

    send(method, args)     # frame + ship one command
    recv(timeout_s) -> rep # one decoded reply dict (may time out)
    call(method, args, timeout_s)  # send + recv

A reply is ``{"id", "ok", "r" | "e", "load"}``: ``id`` echoes the
command id, ``ok=False`` carries the worker-side exception as
``{"type", "msg"}`` (surfaced here as :class:`RemoteError`), and every
reply piggybacks the worker's load vector — the heartbeat the router's
health tracking runs on.

Failure taxonomy (what the router's health state machine keys on):

* :class:`TransportTimeout` — no reply inside the deadline.  The call
  is still outstanding; ``recv`` again later and the late reply (if the
  worker was merely straggling) is delivered intact.
* :class:`TransportClosed` — the peer is gone (EOF, ECONNRESET, kill):
  grounds for immediate failover.
* :class:`RemoteError` — the worker executed the command and raised; a
  normal application error (e.g. ``OutOfPages`` from ``inject_slot``).

Two implementations:

* :class:`LoopbackTransport` — the worker lives in-process, but every
  command and reply still round-trips through the frame codec
  byte-faithfully, so the fast tests exercise the real wire format.
  Test hooks: ``kill()`` (peer death) and ``stall(n)`` (the next ``n``
  recvs time out, then the buffered replies arrive — a straggler).
* :class:`SocketTransport` — a TCP connection to a subprocess worker
  (see :func:`spawn_worker` / :mod:`repro_torch.serving.fleet.worker`).
"""

from __future__ import annotations

import os
import select
import socket
import subprocess
import sys
import time
from collections import deque
from typing import Optional

from repro_torch.serving.fleet import wire


class TransportError(RuntimeError):
    """Base class for transport-level failures."""


class TransportClosed(TransportError):
    """The peer is gone: EOF, connection reset, or killed."""


class TransportTimeout(TransportError):
    """No reply within the deadline; the call remains outstanding."""


class RemoteError(TransportError):
    """The worker executed the command and raised ``etype``: ``msg``."""

    def __init__(self, etype: str, msg: str):
        super().__init__(f"{etype}: {msg}")
        self.etype = etype


def unwrap(rep: dict):
    """Reply dict → result, raising :class:`RemoteError` on ``ok=False``."""
    if rep.get("ok"):
        return rep.get("r")
    e = rep.get("e") or {}
    raise RemoteError(e.get("type", "Error"), e.get("msg", "?"))


class Transport:
    def send(self, method: str, args: dict) -> None:
        raise NotImplementedError

    def recv(self, timeout_s: Optional[float] = None) -> dict:
        raise NotImplementedError

    def call(self, method: str, args: dict | None = None,
             timeout_s: Optional[float] = None) -> dict:
        self.send(method, args or {})
        return self.recv(timeout_s)

    def close(self) -> None:
        pass


class LoopbackTransport(Transport):
    """In-process worker behind the full wire codec (byte-faithful)."""

    def __init__(self, host, max_payload: int = wire.MAX_PAYLOAD):
        self.host = host
        self._alive = True
        self._replies: deque[bytes] = deque()   # framed, undelivered
        self._stalled = 0
        self._rx = wire.FrameDecoder(max_payload)
        self._tx = wire.FrameDecoder(max_payload)
        self._next_id = 0
        self.max_payload = max_payload

    def send(self, method: str, args: dict) -> None:
        if not self._alive:
            raise TransportClosed("loopback worker is gone")
        msg = {"id": self._next_id, "m": method, "a": args}
        self._next_id += 1
        # the command round-trips through frame + codec before the worker
        # sees it — the loopback's whole point is byte-faithfulness
        payloads = self._tx.feed(wire.frame(wire.encode(msg),
                                            self.max_payload))
        assert len(payloads) == 1
        rep = self.host.handle(wire.decode(payloads[0]))
        self._replies.append(wire.frame(wire.encode(rep), self.max_payload))

    def recv(self, timeout_s: Optional[float] = None) -> dict:
        if not self._alive:
            raise TransportClosed("loopback worker is gone")
        if self._stalled > 0:
            self._stalled -= 1
            raise TransportTimeout("injected straggle")
        if not self._replies:
            raise TransportTimeout("no reply outstanding")
        payloads = self._rx.feed(self._replies.popleft())
        assert len(payloads) == 1
        return wire.decode(payloads[0])

    # ------------------------------------------------------ test hooks
    def kill(self) -> None:
        """Simulate worker death: every later send/recv raises
        :class:`TransportClosed` (undelivered replies are lost)."""
        self._alive = False

    def stall(self, n: int) -> None:
        """The next ``n`` recvs time out; replies stay buffered and are
        delivered after — a recoverable straggler."""
        self._stalled += n

    def close(self) -> None:
        self._alive = False


class SocketTransport(Transport):
    """TCP connection to a subprocess worker.  ``proc`` (when this side
    spawned the worker) is exposed so chaos tests can SIGKILL it."""

    def __init__(self, sock: socket.socket,
                 proc: Optional[subprocess.Popen] = None,
                 max_payload: int = wire.MAX_PAYLOAD):
        self.sock = sock
        self.proc = proc
        self._rx = wire.FrameDecoder(max_payload)
        self._ready: deque[bytes] = deque()
        self._next_id = 0
        self._closed = False
        self.max_payload = max_payload
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def send(self, method: str, args: dict) -> None:
        if self._closed:
            raise TransportClosed("transport closed")
        msg = {"id": self._next_id, "m": method, "a": args}
        self._next_id += 1
        try:
            self.sock.sendall(wire.frame(wire.encode(msg), self.max_payload))
        except OSError as e:
            raise TransportClosed(f"send failed: {e}") from e

    def recv(self, timeout_s: Optional[float] = None) -> dict:
        if self._closed:
            raise TransportClosed("transport closed")
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while not self._ready:
            if deadline is None:
                self.sock.settimeout(None)
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TransportTimeout(
                        f"no reply within {timeout_s:.3f}s")
                self.sock.settimeout(remaining)
            try:
                data = self.sock.recv(1 << 16)
            except socket.timeout as e:   # subclass of OSError: catch first
                raise TransportTimeout(
                    f"no reply within {timeout_s:.3f}s") from e
            except OSError as e:
                raise TransportClosed(f"recv failed: {e}") from e
            if not data:
                raise TransportClosed("worker closed the connection")
            # partial frames stay buffered in the decoder across recvs
            self._ready.extend(self._rx.feed(data))
        return wire.decode(self._ready.popleft())

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass

    def terminate(self, timeout_s: float = 5.0) -> None:
        """Close the connection and reap the subprocess (if ours)."""
        self.close()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                pass


READY_PREFIX = "FLEET-WORKER-READY port="


def spawn_worker(arch: str, *, reduced: bool = True, max_batch: int = 4,
                 max_seq: int = 128, page_size: int = 16, eos_id: int = -1,
                 num_pages: int = 0, kv_tier: str = "none",
                 overlap: bool = False, policy: str = "fcfs",
                 chunk_prefill: int = 0, seed: int = 0,
                 kv_dtype: str = "bf16", quant: str = "none",
                 device: str = "cuda",
                 startup_timeout_s: float = 300.0) -> SocketTransport:
    """Launch ``python -m repro_torch.serving.fleet.worker`` and connect
    to it.

    The worker rebuilds its params from ``(arch, reduced, seed, max_seq,
    quant)`` on ``device`` by the serving driver's calls (``init_params``
    from a seeded generator on the device, then ``quantize_params``), so
    nothing heavy ships over the wire and every worker of a fleet holds
    the bits the driver's single engine holds on the same device.
    """
    import repro_torch
    src_dir = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_dir + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.serving.fleet.worker",
           "--arch", arch, "--reduced", str(int(reduced)),
           "--port", "0", "--max-batch", str(max_batch),
           "--max-seq", str(max_seq), "--page-size", str(page_size),
           "--eos-id", str(eos_id), "--num-pages", str(num_pages),
           "--kv-tier", kv_tier, "--policy", policy,
           "--chunk-prefill", str(chunk_prefill), "--seed", str(seed),
           "--kv-dtype", kv_dtype, "--quant", quant, "--device", device]
    if overlap:
        cmd.append("--overlap")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    deadline = time.monotonic() + startup_timeout_s
    lines: list[str] = []
    port = None
    while port is None:
        if proc.poll() is not None:
            raise TransportError(
                f"worker exited with {proc.returncode} before ready:\n"
                + "".join(lines[-20:]))
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            proc.kill()
            raise TransportError(
                f"worker not ready within {startup_timeout_s}s:\n"
                + "".join(lines[-20:]))
        r, _, _ = select.select([proc.stdout], [], [], min(remaining, 1.0))
        if not r:
            continue
        line = proc.stdout.readline()
        if not line:
            continue
        lines.append(line)
        if line.startswith(READY_PREFIX):
            port = int(line[len(READY_PREFIX):].strip())
    sock = socket.create_connection(("127.0.0.1", port), timeout=30.0)
    return SocketTransport(sock, proc=proc)
