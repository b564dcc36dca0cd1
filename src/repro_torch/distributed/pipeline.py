"""GPipe-style pipeline parallelism over the ``pod`` axis (multi-pod
option), the port's copy of ``repro.distributed.pipeline``.

For models whose per-pod weight residency is the constraint,
``pipelined_forward`` runs the layer stack split into ``pod`` stages with
microbatch rotation by ``ppermute`` (all stages run the same program;
microbatch m enters stage s at step m + s).
"""

from __future__ import annotations

import torch


def pipelined_forward(layer_fn, stage_params, x_microbatches: torch.Tensor,
                      mesh, axis: str = "pod") -> torch.Tensor:
    """Run ``x`` through layers split into ``n = |axis|`` stages.

    layer_fn(stage_params, x) -> x; ``stage_params``: this rank's stage
    (the slice ``P(axis)`` of the stacked per-stage params gives, its
    stage axis dropped); x_microbatches: [m, mb, ...] microbatched inputs,
    the same on every rank.  Returns [m, mb, ...] on every rank: the last
    stage's outputs, made replicated by a psum of masked contributions."""
    n = mesh.axis_size(axis)
    stage = mesh.axis_index(axis)
    xs = x_microbatches
    m = xs.shape[0]
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for t in range(m + n - 1):
        # stage 0 ingests microbatch t (if any); others take the permuted
        # output of the previous stage from the previous step
        inp = xs[min(max(t, 0), m - 1)] if stage == 0 else buf
        out = layer_fn(stage_params, inp)
        # rotate stage s -> s+1
        buf = mesh.ppermute(out, axis, perm)
        # last stage emits microbatch t-(n-1)
        if t >= n - 1 and stage == n - 1:
            outs[t - (n - 1)] = out
    # broadcast the last stage's outputs to every stage (psum of masked
    # contributions)
    if stage != n - 1:
        outs = torch.zeros_like(outs)
    return mesh.psum(outs, axis)
