"""A device mesh over ``torch.distributed`` ranks: the port's counterpart of
``jax.sharding.Mesh`` and of the ``jax.lax`` collectives that the JAX
package's ``shard_map`` bodies call.

The port runs SPMD ranks, one process per shard.  Where JAX traces one
program over a mesh and ``shard_map`` hands each device its slice, every
rank here runs the body itself on the slice it holds, and a collective is
a call on the ``Mesh``:

    mesh.axis_index(axis)  mesh.axis_size(axis)
    mesh.psum(x, axis)     mesh.pmax(x, axis)
    mesh.all_gather(x, axis[, async_op=True])    -> [n, *x.shape]
    mesh.ppermute(x, axis, perm)                  perm: [(src, dst), ...]

``axis`` is a mesh axis name, or a tuple of names (taken major to minor,
as a ``PartitionSpec`` entry lists them).  Ranks are laid out row-major
over the axes in JAX's order (``("data", "model")`` or ``("pod", "data",
"model")``), as ``jax.make_mesh`` reshapes its devices.

**A sum has one order.**  ``psum`` is an all-gather followed by a sum in
rank order (``((x_0 + x_1) + x_2) + ...``), never the backend's ring or
tree, so a float32 result's bits do not depend on the backend or the
world size's factorisation (the port's rule: one fixed order a sum).

**The backend is explicit.**  ``run_spmd(fn, world, backend, device)``
takes ``"gloo"`` or ``"nccl"`` and prints the line it runs with.  gloo
takes CUDA tensors for ``all_reduce`` and ``broadcast`` only, so on the
card this module stages the tensors of ``all_gather`` and ``ppermute``
through the host, in this one place; NCCL moves them on the device (one
card per rank: NCCL refuses two ranks on one GPU).  ``nccl`` with CPU
tensors raises; nothing switches backends quietly.

``Mesh.moved`` counts the bytes this rank sent, per collective (an
all-gather of x over n ranks sends x's bytes to each of the n - 1 others).
"""

from __future__ import annotations

import collections
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def backend_line(backend: str, device: torch.device) -> str:
    """The line ``run_spmd`` prints: the backend and what it stages."""
    if backend == "gloo" and device.type == "cuda":
        return ("backend gloo, cuda tensors staged through the host for "
                "all_gather/ppermute")
    return f"backend {backend}, {device.type} tensors, nothing staged"


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Pending:
    """An all-gather in flight (``Mesh.all_gather(..., async_op=True)``):
    ``wait()`` returns the stacked result on the input's device."""

    def __init__(self, works, parts, order, device):
        self._works, self._parts = works, parts
        self._order, self._device = order, device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return torch.stack([self._parts[i] for i in self._order]).to(
            self._device)


class Mesh:
    """The mesh ``shape`` (sizes in the order of ``names``) over the
    global ``ranks`` (all of the default group's by default), row-major.

    Building one is collective: every process of the default group calls
    it with the same arguments (``dist.new_group`` for each line of ranks
    along each axis).  A process outside ``ranks`` gets a mesh with
    ``member`` False, on which no collective may be called."""

    def __init__(self, shape, names, ranks=None):
        shape, names = tuple(int(s) for s in shape), tuple(names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and names {names} differ")
        ranks = list(range(dist.get_world_size())) if ranks is None \
            else [int(r) for r in ranks]
        if len(ranks) != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"ranks, got {len(ranks)}")
        self.names = names
        self.shape = dict(zip(names, shape))   # jax's mesh.shape
        self.ranks = ranks
        self.backend = dist.get_backend()
        me = dist.get_rank()
        self.member = me in ranks
        grid = np.arange(len(ranks)).reshape(shape)
        self.coords: dict[str, int] = {}
        if self.member:
            pos = np.unravel_index(ranks.index(me), shape)
            self.coords = {n: int(c) for n, c in zip(names, pos)}
        self._lines: dict[str, list[int]] = {}
        self._groups: dict = {}
        for i, name in enumerate(names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                glob = [ranks[p] for p in line]
                if len(glob) == 1:
                    if me in glob:
                        self._lines[name] = glob
                    continue
                group = dist.new_group(glob)
                if me in glob:
                    self._lines[name], self._groups[name] = glob, group
        self.moved: collections.Counter = collections.Counter()

    # -- axis queries --------------------------------------------------------

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (a tuple: major to minor)."""
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[a] for a in _axes(axis))

    # -- collectives -----------------------------------------------------------

    def _staged(self, x: torch.Tensor) -> bool:
        if self.backend == "nccl" and not x.is_cuda:
            raise ValueError("the nccl backend takes CUDA tensors; run CPU "
                             "ranks on gloo")
        return self.backend == "gloo" and x.is_cuda

    def _gather_one(self, x: torch.Tensor, axis: str, async_op: bool,
                    kind: str):
        line = self._lines[axis]
        n = len(line)
        if n == 1:
            return Pending([], [x], [0], x.device)
        src = x.detach().cpu() if self._staged(x) else x.detach()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        work = dist.all_gather(parts, src, group=self._groups[axis],
                               async_op=async_op)
        self.moved[kind] += src.numel() * src.element_size() * (n - 1)
        # the group's ranks are its sorted global ranks; put them in axis
        # order
        srt = sorted(line)
        order = [srt.index(r) for r in line]
        return Pending([work] if async_op else [], parts, order, x.device)

    def all_gather(self, x: torch.Tensor, axis, async_op: bool = False,
                   kind: str = "all_gather"):
        """x from every rank along ``axis``, stacked in axis order:
        [n, *x.shape] (``jax.lax.all_gather``).  ``async_op``: a
        ``Pending`` whose ``wait()`` gives it (one axis only)."""
        axes = _axes(axis)
        if async_op:
            if len(axes) != 1:
                raise ValueError("an asynchronous all-gather takes one axis")
            return self._gather_one(x, axes[0], True, kind)
        out = x[None]
        for a in reversed(axes):   # minor axis first: major-to-minor order
            g = self._gather_one(out, a, False, kind).wait()
            out = g.reshape(-1, *x.shape)
        return out

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The sum over ``axis`` in rank order (an all-gather, then
        ``((x_0 + x_1) + x_2) + ...``): the same bits on every rank and
        for any backend."""
        parts = self.all_gather(x, axis, kind="psum")
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        return self.all_gather(x, axis, kind="pmax").amax(0)

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm) -> torch.Tensor:
        """``jax.lax.ppermute``: the rank at axis index ``src`` sends x to
        the one at ``dst`` for each pair (src, dst) of ``perm``; a rank
        that no pair sends to gets zeros."""
        me = self.coords[axis]
        line = self._lines[axis]
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        staged = self._staged(x)
        out = torch.zeros_like(x)
        send = x.detach().cpu().contiguous() if staged \
            else x.detach().contiguous()
        recv = torch.empty_like(send)
        ops = []
        for d in dst:
            if d == me:
                continue
            ops.append(dist.isend(send, line[d],
                                  group=self._groups[axis]))
            self.moved["ppermute"] += send.numel() * send.element_size()
        got = False
        for s in src:
            if s == me:
                out = x.clone()
                continue
            ops.append(dist.irecv(recv, line[s], group=self._groups[axis]))
            got = True
        for op in ops:
            op.wait()
        if got:
            out = recv.to(x.device)
        return out

    def broadcast(self, x: torch.Tensor, axis, src: int = 0) -> torch.Tensor:
        """x of the rank at index ``src`` along ``axis``, on every rank."""
        return self.all_gather(x, axis, kind="broadcast")[src]


# ---------------------------------------------------------------------------
# spawning the ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn, world: int, backend: str, device: str,
               tmp: str, args: tuple) -> None:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)   # on a card: TF32 off, as in one process
    if dev.type == "cpu":
        # the ranks are the parallelism: one intra-op thread each
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_spmd(fn, world: int, backend: str, device: str | torch.device,
             args: tuple = (), timeout: float = 600.0,
             log=print) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` spawned ranks that
    share a ``torch.distributed`` group over ``backend`` (rendezvous in a
    fresh ``FileStore``, so runs side by side never share a port) and
    return each rank's result (``torch.save``-able) in rank order.

    ``fn`` is a module-level function (the ranks import it).  Each rank
    calls ``device.resolve_device`` (which turns TF32 off on a card);
    CPU ranks run one intra-op thread each; on CUDA rank r takes card r
    modulo the card count.  A rank that raises makes this raise (its
    traceback in the message) after the others are stopped; so does a
    run past ``timeout`` seconds."""
    from repro_torch.device import resolve_device

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend takes CUDA tensors; run CPU ranks "
                         "on gloo")
    log(f"run_spmd: {world} ranks on {dev.type}, "
        f"{backend_line(backend, dev)}")
    tmp = tempfile.mkdtemp(prefix="spmd-")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, backend, dev.type, tmp, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_spmd: {world} ranks still running "
                                   f"after {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
