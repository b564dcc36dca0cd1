"""The port's distributed cases, run by every rank of one 8-rank gloo run
on the CPU (``repro_torch.distributed.mesh.run_spmd``), for
tests/test_torch_distributed.py.  Imports no JAX: the ranks load their
inputs (the bridged params and the numpy inputs) from a file the test
writes.

Every rank builds every mesh (building one is collective), in one order,
and runs the cases of the meshes it is a member of:

  moe_2x4, moe_1x2  expert-parallel ``moe_ffn`` (each rank only its
                    experts) and the local path on the same rank
  splitk            prefill, then ``decode_step`` under a (1, 4) mesh on
                    this rank's cache rows (``reshard_cache``)
  pipeline          ``pipelined_forward`` over 4 stages
  stream            ``streamed_matmul_chain`` and ``alpha_split_matmul``
                    over 8 ranks, with the bytes each collective sent
  psum_compressed   rank r's gradient is row r
  elastic_<n>       smollm-360m reduced resharded over n = 8, 6, 4 ranks
                    (``make_elastic_mesh``, prefer_model 4), gathered back
"""

import dataclasses

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.distributed import ctx
from repro_torch.distributed.elastic import (gather_tree, make_elastic_mesh,
                                             reshard_cache, reshard_params)
from repro_torch.distributed.grad_compress import psum_compressed
from repro_torch.distributed.hybrid_stream import (alpha_split_matmul,
                                                   streamed_matmul_chain)
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.pipeline import pipelined_forward
from repro_torch.distributed.sharding import P, local_shard
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

ELASTIC = (8, 6, 4)
ELASTIC_ARCH = "smollm-360m"


def _ep_and_local(p, x, cfg, mesh):
    mine = dict(p)
    for k in ("up", "gate", "down"):
        mine[k] = local_shard(p[k], P("model", None, None), mesh).clone()
    with ctx.lowering_ctx(mesh=mesh):
        y = MOE.moe_ffn(mine, x, cfg)
    return y, MOE.moe_ffn(p, x, cfg), mine["up"].shape[0]


def _moe(inp, mesh):
    """JAX's float32 case, and the full config's top-4 in bf16 over the
    port's own weights (a token's 4 outputs summed across ranks)."""
    cfg = get_arch(inp["moe_arch"]).reduced()
    y, local, experts = _ep_and_local(inp["moe_params"], inp["moe_x"], cfg,
                                      mesh)
    top4 = dataclasses.replace(cfg, top_k=get_arch(inp["moe_arch"]).top_k)
    gen = torch.Generator().manual_seed(3)
    p16 = MOE.init_moe(gen, top4, torch.bfloat16, torch.device("cpu"))
    x16 = torch.randn(inp["moe_x"].shape, generator=gen).to(torch.bfloat16)
    y16, local16, _ = _ep_and_local(p16, x16, top4, mesh)
    return {"y": y, "local": local, "experts": experts, "y_bf16": y16,
            "local_bf16": local16}


def _splitk(inp, mesh):
    cfg = get_arch(inp["decode_arch"]).reduced()
    params, prompt = inp["decode_params"], inp["decode_prompt"]
    b, max_seq = prompt.shape[0], inp["decode_max_seq"]
    cache = M.init_cache(cfg, b, max_seq, dtype=torch.float32, device="cpu")
    _, cache = M.prefill(params, cfg, prompt, cache)
    mine = reshard_cache(cache, mesh, b)
    local = {k: v.local for k, v in mine.items()}
    logits = []
    with ctx.lowering_ctx(mesh=mesh):
        for t in inp["decode_tokens"]:
            lg, local = M.decode_step(params, cfg, t, local)
            logits.append(lg)
    return {"logits": torch.stack(logits), "k": local["k"],
            "v": local["v"], "spec": tuple(mine["k"].spec),
            "len": int(local["len"])}


def _pipeline(inp, mesh):
    ws, xs = inp["pipe_ws"], inp["pipe_xs"]
    stage_w = local_shard(ws, P("pod"), mesh)[0]
    return pipelined_forward(lambda w, x: torch.tanh(x @ w), stage_w, xs,
                             mesh, "pod")


def _stream(inp, mesh):
    x, ws = inp["stream_x"], inp["stream_ws"]
    shards = [local_shard(w, P("data", None), mesh).clone() for w in ws]
    mesh.moved.clear()
    out = {"chain": streamed_matmul_chain(x, shards, mesh, "data"),
           "chain_moved": dict(mesh.moved)}
    for a in inp["alphas"]:
        out[f"alpha{a}"] = alpha_split_matmul(x, shards[0], mesh, a)
    return out


def _elastic(inp, mesh):
    cfg = get_arch(ELASTIC_ARCH).reduced()
    host = M.init_params(cfg, seed=0, max_seq=32, device="cpu",
                         dtype=torch.float32)
    sharded = reshard_params(host, mesh)
    back = gather_tree(sharded, mesh)
    leaves = list(zip(_leaves(host), _leaves(back)))
    local = sum(s.local.numel() for s in _leaves(sharded))
    toks = inp["elastic_tokens"]
    return {"same_bits": all(torch.equal(a, b) for a, b in leaves),
            "leaves": len(leaves), "local_elems": local,
            "total_elems": sum(a.numel() for a, _ in leaves),
            "forward_equal": torch.equal(M.forward(host, cfg, toks),
                                         M.forward(back, cfg, toks)),
            "shape": dict(mesh.shape)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def run_all(rank, dev, inputs_path):
    inp = torch.load(inputs_path, weights_only=False)
    meshes = {
        "moe_2x4": Mesh((2, 4), ("data", "model")),
        "moe_1x2": Mesh((1, 2), ("data", "model"), ranks=[0, 1]),
        "splitk": Mesh((1, 4), ("data", "model"), ranks=[0, 1, 2, 3]),
        "pipeline": Mesh((4,), ("pod",), ranks=[0, 1, 2, 3]),
        "stream": Mesh((8,), ("data",)),
    }
    for n in ELASTIC:
        meshes[f"elastic_{n}"] = make_elastic_mesh(range(n), prefer_model=4)
    out = {}
    for name, mesh in meshes.items():
        if not mesh.member:
            continue
        if name.startswith("moe"):
            out[name] = _moe(inp, mesh)
        elif name == "splitk":
            out[name] = _splitk(inp, mesh)
        elif name == "pipeline":
            out[name] = _pipeline(inp, mesh)
        elif name == "stream":
            out[name] = _stream(inp, mesh)
            out["psum_compressed"] = psum_compressed(
                inp["grad"][rank], "data", mesh)
        else:
            out[name] = _elastic(inp, mesh)
    return out
