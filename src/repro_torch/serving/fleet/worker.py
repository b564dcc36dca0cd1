"""Fleet worker: one EngineCore behind the wire protocol.

The port's own copy of ``repro.serving.fleet.worker``: the same command
surface, CLI (plus ``--device``, ``cuda`` by default) and ready line.

:class:`WorkerHost` is the transport-independent half — it maps decoded
command messages onto the EngineCore command surface and wraps every
reply with the worker's load vector (the heartbeat).  The loopback
transport calls ``handle`` directly; :func:`serve` is the socket server
loop around it; :func:`main` is the standalone entry point::

    python -m repro_torch.serving.fleet.worker --arch smollm-360m --port 0

The worker prints ``FLEET-WORKER-READY port=<n>`` once it is listening
(``--port 0`` picks an ephemeral port), then serves one router
connection until EOF or a ``shutdown`` command.

Command surface (mirrors EngineCore; see fleet/README.md for the wire
protocol):

==================  ====================================================
``ping``            liveness probe; returns the worker name
``add_request``     ``{"req": Request}`` → True
``abort``           ``{"rid"}`` → bool (terminal event follows via step)
``step``            one admit+decode round → ``{"events": [...]}``
``snapshot_slot``   ``{"rid"}`` → SlotSnapshot (slot released: migration)
``inject_slot``     ``{"snap": SlotSnapshot}`` → slot index
``checkpoint``      non-destructive snapshots of every active slot →
                    ``{"snaps": {rid: bytes}}`` (the failover souce)
``migration_candidate`` / ``can_accept`` — the router's migration probes
``stats``           EngineStats as a field map
``shutdown``        stop serving after this reply
==================  ====================================================

Params are rebuilt locally from ``(arch, reduced, seed, max_seq, quant)``
by the serving driver's own calls (``launch/serve.py`` ``build_client``:
``init_params`` from a seeded generator on the device, then
``quantize_params``), so every worker of a fleet, and the driver's single
engine on the same device, hold the same bits without shipping them.
"""

from __future__ import annotations

import argparse
import dataclasses
import socket

from repro_torch.serving.core import EngineCore
from repro_torch.serving.fleet import wire


class WorkerHost:
    """One EngineCore behind the command protocol (transport-agnostic)."""

    def __init__(self, core: EngineCore, name: str = "worker"):
        self.core = core
        self.name = name
        self.shutdown_requested = False

    # ------------------------------------------------------------------
    def load(self) -> dict:
        """The load vector piggybacked on every reply — what the router
        routes and health-checks on."""
        c = self.core
        return {"queue_depth": c.queue_depth, "n_active": c.n_active,
                "n_free_slots": c.n_free_slots, "free_pages": c.free_pages,
                "page_starved": c.page_starved, "has_work": c.has_work}

    def handle(self, msg) -> dict:
        """Decoded command message → reply dict (ready to encode)."""
        if not isinstance(msg, dict) or "m" not in msg:
            return {"id": -1, "ok": False,
                    "e": {"type": "ProtocolError",
                          "msg": f"malformed command {type(msg).__name__}"},
                    "load": self.load()}
        try:
            rep = {"id": msg.get("id", -1), "ok": True,
                   "r": self._dispatch(msg["m"], msg.get("a") or {})}
        except Exception as e:   # ships to the router as a RemoteError
            rep = {"id": msg.get("id", -1), "ok": False,
                   "e": {"type": type(e).__name__, "msg": str(e)}}
        rep["load"] = self.load()
        return rep

    def _dispatch(self, method: str, args: dict):
        core = self.core
        if method == "ping":
            return self.name
        if method == "add_request":
            core.add_request(args["req"])
            return True
        if method == "abort":
            return core.abort_request(args["rid"])
        if method == "step":
            # mirror Router.step's per-replica round: advance only with
            # work, but always drain (an abort's terminal may be queued)
            if core.has_work:
                core._advance()
            return {"events": core.drain_outputs()}
        if method == "snapshot_slot":
            return core.snapshot_slot(args["rid"])
        if method == "inject_slot":
            return core.inject_slot(args["snap"])
        if method == "checkpoint":
            return {"snaps": self._checkpoint()}
        if method == "migration_candidate":
            return core.migration_candidate()
        if method == "can_accept":
            return core.can_accept(args["n_pages"])
        if method == "stats":
            return {f.name: getattr(core.stats, f.name)
                    for f in dataclasses.fields(core.stats)}
        if method == "shutdown":
            self.shutdown_requested = True
            return True
        raise ValueError(f"unknown fleet command {method!r}")

    def _checkpoint(self) -> dict:
        """Non-destructive snapshot of every active slot, serialized —
        what the router persists and replays from on failover."""
        snaps = {}
        if self.core.mode != "continuous":
            return snaps
        for req in list(self.core.slots):
            if req is not None:
                snaps[req.rid] = self.core.snapshot_slot(
                    req.rid, release=False).to_bytes()
        return snaps


def serve(host: WorkerHost, port: int = 0,
          max_payload: int = wire.MAX_PAYLOAD) -> None:
    """Blocking socket server: one router connection, frames in/out."""
    srv = socket.create_server(("127.0.0.1", port))
    print(f"FLEET-WORKER-READY port={srv.getsockname()[1]}", flush=True)
    conn, _ = srv.accept()
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    dec = wire.FrameDecoder(max_payload)
    try:
        while not host.shutdown_requested:
            data = conn.recv(1 << 16)
            if not data:
                break
            for payload in dec.feed(data):
                try:
                    msg = wire.decode(payload)
                except wire.ProtocolError as e:
                    rep = {"id": -1, "ok": False,
                           "e": {"type": "ProtocolError", "msg": str(e)},
                           "load": host.load()}
                else:
                    rep = host.handle(msg)
                conn.sendall(wire.frame(wire.encode(rep), max_payload))
    finally:
        conn.close()
        srv.close()


def build_core(arch: str, *, reduced: bool = True, max_batch: int = 4,
               max_seq: int = 128, page_size: int = 16, eos_id: int = -1,
               num_pages: int = 0, kv_tier: str = "none",
               overlap: bool = False, policy: str = "fcfs",
               chunk_prefill: int = 0, seed: int = 0,
               kv_dtype: str = "bf16", quant: str = "none",
               device: str = "cuda") -> EngineCore:
    """The worker's engine; its params come from :func:`build_params`."""
    from repro_torch.serving.scheduler import make_scheduler

    cfg, params = build_params(arch, reduced=reduced, max_seq=max_seq,
                               seed=seed, quant=quant, device=device)
    return EngineCore(
        cfg, params, max_batch=max_batch, max_seq=max_seq, eos_id=eos_id,
        page_size=page_size, num_pages=num_pages or None, kv_tier=kv_tier,
        overlap=overlap, kv_dtype=kv_dtype,
        scheduler=make_scheduler(policy, chunk_tokens=chunk_prefill or None),
        device=device)


def build_params(arch, *, reduced: bool = True, max_seq: int = 128,
                 seed: int = 0, quant: str = "none", device: str = "cuda"):
    """(cfg, params) by the calls ``launch/serve.py`` ``build_client``
    makes: ``init_params`` on ``device`` from ``seed``, each top-level
    entry and each layer (W8A8 or W4A16) through ``quantize_params`` as
    soon as it is made, so no more than one layer's bf16 weights are alive
    (qwen2-vl-72b and llama2-70b fit one card that way).  The draws are
    the deterministic init's, so every worker derives the same quantized
    weights, the bits of the whole model's init quantized after.  ``arch``
    is a registered name or a ``ModelConfig`` (a configuration cut to
    fewer layers draws the same first layers as the whole one)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as model_lib

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    finish = None
    if quant in ("w8a8", "w4a16"):
        from repro_torch.quant.convert import quantize_params

        def finish(tree, stacked: bool):
            return quantize_params(tree, consume=True, mode=quant,
                                   _stacked=stacked)
    elif quant != "none":
        raise ValueError(f"unknown quantization {quant!r}")
    params = model_lib.init_params(cfg, seed=seed, max_seq=max_seq,
                                   device=device, finish=finish)
    return cfg, params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral; the bound port is announced on "
                         "stdout as FLEET-WORKER-READY port=<n>")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--num-pages", type=int, default=0)
    ap.add_argument("--kv-tier", default="none", choices=("none", "flash"))
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"))
    ap.add_argument("--quant", default="none",
                    choices=("none", "w8a8", "w4a16"))
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--policy", default="fcfs")
    ap.add_argument("--chunk-prefill", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="param init seed — must match the fleet's")
    ap.add_argument("--name", default="worker")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    core = build_core(
        args.arch, reduced=bool(args.reduced), max_batch=args.max_batch,
        max_seq=args.max_seq, page_size=args.page_size, eos_id=args.eos_id,
        num_pages=args.num_pages, kv_tier=args.kv_tier,
        overlap=args.overlap, policy=args.policy,
        chunk_prefill=args.chunk_prefill, seed=args.seed,
        kv_dtype=args.kv_dtype, quant=args.quant, device=args.device)
    serve(WorkerHost(core, name=args.name), port=args.port)


if __name__ == "__main__":
    main()
