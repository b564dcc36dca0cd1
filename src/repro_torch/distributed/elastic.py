"""Elastic scaling: re-shard a job onto a different rank count, the port's
copy of ``repro.distributed.elastic``.

When ranks are lost, the job restarts on N' != N ranks.  Because
checkpoints store leaves unsharded (``distributed/checkpoint.py``) and
every sharding is derived (the name+shape rules of
``distributed/sharding.py``), an elastic restart is: build the mesh over
the surviving ranks (``make_elastic_mesh``, whose shape ``plan_remesh``
picks), derive the specs and cut each rank's slices out of the restored
host tree (``reshard_params`` / ``reshard_cache``).

The port has no GSPMD: a sharded leaf is a ``Sharded`` pair, this rank's
slice and its spec, and no model function takes one.  A ``forward`` over
a resharded tree runs on the tree put back together
(``gather_tree``, collective).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.mesh import Mesh


class Sharded(NamedTuple):
    local: torch.Tensor     # this rank's slice
    spec: shd.PartitionSpec


def plan_remesh(n_devices: int, prefer_model: int = 16,
                multi_pod_threshold: int = 512) -> tuple[tuple, tuple]:
    """Choose (shape, axis_names) for an arbitrary surviving device count.

    Keeps the model axis as close to ``prefer_model`` as divisibility allows
    (TP degree changes invalidate head-sharding less often than data-axis
    changes invalidate nothing).
    """
    model = math.gcd(n_devices, prefer_model)
    rest = n_devices // model
    if n_devices >= multi_pod_threshold and rest % 2 == 0:
        if rest >= 2:
            shape = (2, rest // 2, model)
        else:   # model axis swallowed every device: a single "pod"
            shape = (1, rest, model)
        return shape, ("pod", "data", "model")
    return (rest, model), ("data", "model")


def make_elastic_mesh(ranks=None, prefer_model: int = 16) -> Mesh:
    """A mesh over the surviving global ``ranks`` (all by default),
    shaped by ``plan_remesh``.  Collective over the default group."""
    import torch.distributed as dist

    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    shape, names = plan_remesh(len(ranks), prefer_model)
    return Mesh(shape, names, ranks)


def _reshard(tree, specs, mesh: Mesh):
    return shd.tree_map_paths(
        lambda path, t: Sharded(
            shd.local_shard(t, _at(specs, path), mesh).clone(),
            _at(specs, path)), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def reshard_params(params, mesh: Mesh, zero3: bool = True):
    """This rank's ``Sharded`` slice of every leaf of a (restored, host)
    param tree, by ``param_pspec``."""
    return _reshard(params, shd.params_pspecs(params, mesh, zero3), mesh)


def reshard_cache(cache, mesh: Mesh, batch: int):
    return _reshard(cache, shd.cache_pspecs(cache, mesh, batch), mesh)


def gather_tree(tree, mesh: Mesh):
    """The whole tree from every rank's ``Sharded`` slices (collective)."""
    if isinstance(tree, Sharded):
        return shd.gather_shard(tree.local, tree.spec, mesh)
    if isinstance(tree, dict):
        return {k: gather_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v, mesh) for v in tree]
    return tree
