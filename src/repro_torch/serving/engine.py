"""Single-replica compatibility shim over :mod:`repro_torch.serving.core`.

The port's copy of ``repro.serving.engine``.  The serving stack has three
layers, each with a public API at its seam:

* :class:`repro_torch.serving.core.EngineCore` — the per-replica loop
  (slots, paged / tiered KV, chunked prefill, scheduler calls) behind the
  command surface ``add_request / abort_request / step() ->
  list[RequestOutput] / snapshot_slot / inject_slot``.
* :class:`repro_torch.serving.router.Router` — N replicas behind one
  routing policy, merged output streams, cross-replica slot migration.
* :class:`repro_torch.serving.client.ServingClient` — the user-facing
  handle (``submit() -> RequestHandle``, ``handle.tokens()``,
  ``stream()``, ``abort()``).

``ServingEngine`` is the one-replica shim: the historical surface
(``submit`` / bool-returning ``step`` / ``run`` / ``stream`` /
``drain_outputs``) over an unmodified ``EngineCore``, so a ``Router`` with
one replica gives its outputs token for token.  ``Request``,
``RequestOutput``, ``EngineStats`` and ``SlotSnapshot`` are re-exported
from the core.
"""

from __future__ import annotations

from repro_torch.serving.core import (EngineCore, EngineStats,  # noqa: F401
                                      Request, RequestOutput, SlotSnapshot)

__all__ = ["EngineCore", "EngineStats", "Request", "RequestOutput",
           "ServingEngine", "SlotSnapshot"]


class ServingEngine(EngineCore):
    """One-replica engine with the historical control surface.

    Identical to :class:`EngineCore` except that ``step()`` returns
    whether there was work (a bool) instead of the router-facing
    ``list[RequestOutput]``; events are read through ``stream()`` /
    ``drain_outputs()``.
    """

    def step(self) -> bool:
        return self._advance()
