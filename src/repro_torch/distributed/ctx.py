"""Distribution settings that cut across the model code: the port's copy
of ``repro.distributed.ctx``.

The model zoo stays pure; a caller configures, for a block of calls:
  * ``constrain``    -- a hook applied where the JAX package constrains a
                        sharding (the residual stream at layer boundaries,
                        attention's heads, the logits, the embedding's
                        gradient); the identity by default.  The port has
                        no GSPMD, so a hook is a plain function of
                        ``(x, kind)``;
  * ``remat``        -- each layer of ``models.model.forward`` under
                        ``torch.utils.checkpoint`` (``jax.checkpoint``);
  * ``unroll_scans`` -- accepted and ignored: the port's layer loops are
                        Python loops, already unrolled;
  * ``mesh``         -- a ``distributed.mesh.Mesh``: turns on the sharded
                        paths (split-K decode attention, expert-parallel
                        MoE), each rank holding its slices.
"""

from __future__ import annotations

import contextlib
from typing import Callable

from torch.utils.checkpoint import checkpoint

_STATE = {
    "constrain": None,   # Callable[[Tensor, str], Tensor] | None
    "remat": False,
    "unroll_scans": False,
    "mesh": None,        # distributed.mesh.Mesh | None
}


@contextlib.contextmanager
def lowering_ctx(constrain: Callable | None = None, remat: bool = False,
                 unroll_scans: bool = False, mesh=None):
    old = dict(_STATE)
    _STATE.update(constrain=constrain, remat=remat,
                  unroll_scans=unroll_scans, mesh=mesh)
    try:
        yield
    finally:
        _STATE.update(old)


def mesh():
    return _STATE["mesh"]


def constrain(x, kind: str = "resid"):
    fn = _STATE["constrain"]
    return fn(x, kind) if fn is not None else x


def maybe_remat(f):
    """``f`` recomputed in the backward instead of keeping its activations
    (non-reentrant ``torch.utils.checkpoint``) when ``remat`` is on."""
    if not _STATE["remat"]:
        return f

    def run(*args):
        return checkpoint(f, *args, use_reentrant=False)

    return run
