"""Fleet serving: EngineCore workers behind a wire protocol.

The port's own copy of ``repro.serving.fleet``.  Three pieces:

* :mod:`repro_torch.serving.fleet.wire` — the length-prefixed, versioned
  binary codec every command and reply travels through, including the
  :class:`repro_torch.serving.core.SlotSnapshot` byte format: the JAX
  package's bytes, so each side decodes the other's frames.
* :mod:`repro_torch.serving.fleet.transport` — the transport seam: an
  in-process loopback (byte-faithful — every payload round-trips
  through the codec) and a socket transport driving real subprocess
  workers (:mod:`repro_torch.serving.fleet.worker`).
* :mod:`repro_torch.serving.fleet.router` — the FleetRouter: routing,
  health detection (heartbeat misses / reply deadlines), periodic
  snapshot checkpoints (``repro_torch.distributed.checkpoint``), and
  failover that re-dispatches a dead worker's requests with a
  bit-identical recovered token stream.
"""

from repro_torch.serving.fleet.router import FleetRouter  # noqa: F401
from repro_torch.serving.fleet.transport import (  # noqa: F401
    LoopbackTransport, RemoteError, SocketTransport, TransportClosed,
    TransportError, TransportTimeout, spawn_worker)
from repro_torch.serving.fleet.wire import (  # noqa: F401
    FrameDecoder, ProtocolError)
