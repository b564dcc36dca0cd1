"""The port's sharding rules against the JAX package's, in one process, no
ranks: the rules read only ``mesh.shape``, so both run on a stand-in mesh
(a namespace with a ``shape`` dict) and need no devices.

For every assigned arch at full width and reduced, float and W8A8, over
the meshes (2, 4), (1, 8), (4, 1) and (2, 2, 4) (pod): ``param_pspec`` of
every param (the port's tree from ``init_params`` on the meta device, its
layers lists where JAX stacks them: the port's spec is JAX's less the
leading layer axes, which every rule leaves whole), ``cache_pspec`` of
every wave-cache leaf and ``batch_pspec``, equal spec for spec;
``plan_remesh`` equal to JAX's for 1..1024 devices.
"""

import types

import jax
import pytest
import torch

from repro.configs.registry import ASSIGNED_ARCHS
from repro.distributed import elastic as jel
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import elastic as tel
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.checkpoint import tree_leaves
from repro_torch.models import model as TM
from repro_torch.quant.convert import quantize_params

MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((4, 1), ("data", "model")), ((2, 2, 4), ("pod", "data", "model"))]
MAX_SEQ, BATCH = 64, 8


def _mesh(shape, names):
    return types.SimpleNamespace(shape=dict(zip(names, shape)))


def _port_leaf(tree, keys):
    """The port's leaf at JAX's key path: (path, leaf, stacked axes), a
    list taken at its first item for each axis JAX stacks."""
    path, depth = [], 0
    for k in keys:
        tree = tree[k]
        path.append(k)
        while isinstance(tree, list):
            tree, depth = tree[0], depth + 1
            path.append(0)
    return tuple(path), tree, depth


def _keys(jpath):
    return [getattr(k, "key", getattr(k, "name", getattr(k, "idx", None)))
            for k in jpath]


def _count(tree):
    return len(tree_leaves(tree))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ASSIGNED_ARCHS))
def test_param_and_cache_specs_equal_jax(arch, reduced):
    jcfg, tcfg = ASSIGNED_ARCHS[arch], get_arch(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    checked = 0
    for quant in (False, True):
        jtree = jspecs.param_specs(jcfg, max_seq=MAX_SEQ, quant=quant)
        ttree = TM.init_params(tcfg, max_seq=MAX_SEQ, device="meta")
        if quant:
            ttree = quantize_params(ttree)
        jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
        for jpath, jleaf in jleaves:
            path, leaf, depth = _port_leaf(ttree, _keys(jpath))
            assert tuple(leaf.shape) == tuple(jleaf.shape)[depth:], path
            for shape, names in MESHES:
                m = _mesh(shape, names)
                want = tuple(jshd.param_pspec(jpath, jleaf, m))
                got = tshd.param_pspec(path, leaf.shape, m)
                assert want[:depth] == (None,) * depth, (path, want)
                assert tuple(got) == want[depth:], (path, shape, got, want)
                checked += 1
        # every port leaf is one of JAX's (stacked ones repeat)
        assert _count(ttree) >= len(jleaves)
    jcache = jspecs.cache_specs(jcfg, BATCH, MAX_SEQ)
    tcache = TM.init_cache(tcfg, BATCH, MAX_SEQ, device="meta")
    jc = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(jc) == _count(tcache)
    for jpath, jleaf in jc:
        path, leaf, depth = _port_leaf(tcache, _keys(jpath))
        assert depth == 0 and tuple(leaf.shape) == tuple(jleaf.shape), path
        for shape, names in MESHES:
            for batch in (1, BATCH):
                m = _mesh(shape, names)
                want = tuple(jshd.cache_pspec(jpath, jleaf, m, batch))
                got = tshd.cache_pspec(path, leaf.shape, m, batch)
                assert tuple(got) == want, (path, shape, batch, got, want)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("shape,names", MESHES)
def test_batch_pspec_equal_jax(shape, names):
    m = _mesh(shape, names)
    assert tshd.dp_axes(m) == jshd.dp_axes(m)
    for batch in (1, 2, 3, 4, 6, 8, 16, 32):
        for ndim in (1, 2, 3):
            assert tuple(tshd.batch_pspec(m, batch, ndim)) == \
                tuple(jshd.batch_pspec(m, batch, ndim)), (batch, ndim)


@pytest.mark.parametrize("prefer_model", [4, 16])
def test_plan_remesh_equal_jax(prefer_model):
    for n in range(1, 1025):
        assert tel.plan_remesh(n, prefer_model) == \
            jel.plan_remesh(n, prefer_model), n


def test_local_shard_slices_by_spec():
    """``local_shard`` cuts the slice ``shard_map`` hands a device: a dim
    sharded over (data, model) takes data-major blocks."""
    t = torch.arange(4 * 8 * 3).reshape(4, 8, 3)
    spec = tshd.P("data", ("data", "model"), None)
    for d in range(2):
        for mo in range(2):
            m = types.SimpleNamespace(
                shape={"data": 2, "model": 2},
                axis_size=lambda axes: 2 ** len(axes if isinstance(
                    axes, tuple) else (axes,)),
                axis_index=lambda axes, d=d, mo=mo: (
                    d if axes == ("data",) else d * 2 + mo))
            got = tshd.local_shard(t, spec, m)
            i = d * 2 + mo
            assert torch.equal(got, t[d * 2:(d + 1) * 2, i * 2:(i + 1) * 2])
